"""Model serving: batched prefill + decode loop with the family's cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 32

Runs on the card (``--device cuda``, the default) unless asked for the CPU;
``--no-smoke`` serves the full published configuration.  The prefill runs
the family's kernel (K5 flash attention for the dense and MoE LMs, K6 WKV6
for RWKV6).  A MoE model's prefill drops the (token, slot) pairs past its
experts' capacity; the serve reports their share.

The decode is the reference's jitted, cache-donating ``decode_step``
(``jax.jit(..., donate_argnums=(1,))``): a :class:`DecodeStep` on static
buffers (the token, the position and a step index, each a device tensor,
the prefill's cache tensors themselves, the logits and a ``(B, gen)`` token
buffer).  One step is ``decode_step`` with the cache updated in place, the
greedy pick, the write of the token into the buffer at the step index, and
the increments of position and index: on the card it is captured once as a
CUDA graph, after one eager warm-up step on a clone of the cache, and
replayed ``gen - 1`` times with one read of the token buffer at the end; on
the CPU the same step runs eagerly on the same buffers.  A capture or
replay that fails raises :class:`~repro_torch.kernels.KernelError`; nothing
falls back to the eager loop (:func:`decode_eager`, the yardstick the graph
is held to).

Temperature sampling stays outside the graph: after each replay the same
``softmax`` and ``multinomial`` as the eager loop's run on the static
logits with the serve's ``torch.Generator``, and the token is copied into
the static input.  So no generator is registered with the graph, and the
sampled tokens equal the eager loop's bit for bit.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine_torch import resolve_device
from repro_torch.kernels import KernelError
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models.common import get_family, init_model

#: decode steps captured as CUDA graphs, one a serve call on the card: the
#: counterpart of the reference's one trace of its jitted ``decode_step``
CAPTURE_COUNT = 0


def launch_counts():
    """The kernels' launch counters, by name (read from the wrappers
    themselves, so a run with a wrapper swapped for its plain version counts
    no launch)."""
    return {"flash_attention": flash_attention.launches,
            "wkv6": wkv6.launches}


def make_media(cfg, batch, device=None):
    if cfg.family in ("encdec", "vlm"):
        # frontend stub: deterministic pseudo-embeddings
        rng = np.random.default_rng(0)
        return torch.as_tensor(
            rng.normal(size=(batch, cfg.n_media_tokens, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=device)
    return None


def pick(logits, temperature: float = 0.0, sampler=None):
    """The next token (B, 1) int32 from logits (B, V): the argmax, or a
    sample at ``temperature`` from ``sampler``."""
    if temperature > 0:
        p = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(p, 1, generator=sampler).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


class DecodeStep:
    """One decode step of ``fam`` on static buffers, captured as a CUDA
    graph when ``graph`` is true (the default on the card), run eagerly
    otherwise.

    ``tok`` (B, 1) int32, ``pos`` and ``index`` (1,) int64 and ``tokens``
    (B, gen) int32 are the step's buffers; ``cache`` is the prefill's, and
    the step updates it in place; :meth:`step` returns the static logits
    (B, 1, V).  With ``greedy`` the step also picks the argmax into ``tok``
    and ``tokens[:, index]``; without it the caller samples the token and
    passes it to :meth:`feed`."""

    def __init__(self, fam, model, cfg, cache, gen: int, *, greedy=True,
                 media=None, graph=None):
        some = next(iter(cache.values()))
        dev, B = some.device, some.shape[1]          # caches are (L, B, ...)
        self.fam, self.model, self.cfg, self.cache = fam, model, cfg, cache
        self.media, self.greedy = media, greedy
        self.tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.tokens = torch.zeros((B, gen), dtype=torch.int32, device=dev)
        self.logits = None
        self.graph = None
        if dev.type == "cuda" if graph is None else graph:
            self._capture(dev)

    def _body(self, cache):
        logits, _ = self.fam.decode_step(self.model, self.cfg, cache,
                                         self.tok, self.pos, media=self.media)
        if self.greedy:
            nxt = pick(logits[:, 0])
            self.tokens.index_copy_(1, self.index, nxt)
            self.tok.copy_(nxt)
        self.pos.add_(1)
        self.index.add_(1)
        return logits

    def warm(self):
        """One eager step on a clone of the cache: it makes the parameters'
        cast copies and the BLAS library's state outside the capture and
        leaves the served cache (an RWKV state too) as it was."""
        clone = {k: v.clone() for k, v in self.cache.items()}
        self._body(clone)

    def _capture(self, dev):
        global CAPTURE_COUNT
        try:
            with torch.cuda.device(dev):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self.warm()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    self.logits = self._body(self.cache)
                torch.cuda.current_stream().wait_stream(side)
        except RuntimeError as exc:
            if isinstance(exc, KernelError):
                raise
            raise KernelError(f"decode step of {self.cfg.name}: capturing "
                              f"it as a CUDA graph failed: {exc}") from exc
        self.graph = graph
        CAPTURE_COUNT += 1

    def start(self, tok, pos: int):
        """Set the first token (B, 1), the prefill's pick, at ``tokens[:,
        0]`` and as the input of the step at position ``pos``."""
        self.tok.copy_(tok)
        self.tokens.zero_()
        self.tokens[:, :1].copy_(tok)
        self.pos.fill_(pos)
        self.index.fill_(1)

    def step(self):
        """One step: a replay of the graph, or the step run eagerly ->
        the static logits (B, 1, V).  No host sync."""
        if self.graph is None:
            self.logits = self._body(self.cache)
            return self.logits
        try:
            self.graph.replay()
        except RuntimeError as exc:
            raise KernelError(f"decode step of {self.cfg.name}: replaying "
                              f"its CUDA graph failed: {exc}") from exc
        return self.logits

    def feed(self, tok, i: int):
        """A token sampled outside the step: the next step's input, and
        ``tokens[:, i]``."""
        self.tok.copy_(tok)
        self.tokens[:, i:i + 1].copy_(tok)

    def close(self):
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.logits = None


def decode(fam, model, cfg, cache, first, prompt_len: int, gen: int, *,
           temperature: float = 0.0, sampler=None, media=None, graph=None,
           on_step=None):
    """Decode ``gen - 1`` tokens after ``first`` (B, 1), the token at
    position ``prompt_len``, on a :class:`DecodeStep` (a captured graph on
    the card unless ``graph`` is false).  ``on_step(logits)`` is called
    after each step with the static logits.  -> ``{"tokens": (B, gen)
    int32 array, "capture_s": the step's construction, warm-up and capture
    included, "decode_s": the steps and the read of the tokens}``, both
    synchronised."""
    sync = (torch.cuda.synchronize if first.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    ds = DecodeStep(fam, model, cfg, cache, gen, greedy=temperature <= 0,
                    media=media, graph=graph)
    sync()
    t_capture = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        ds.start(first, prompt_len)
        for i in range(1, gen):
            logits = ds.step()
            if temperature > 0:
                ds.feed(pick(logits[:, 0], temperature, sampler), i)
            if on_step is not None:
                on_step(logits)
        toks = ds.tokens.cpu().numpy()
        sync()
        t_decode = time.perf_counter() - t0
    finally:
        ds.close()
    return {"tokens": toks, "capture_s": t_capture, "decode_s": t_decode}


#: :func:`decode` with the step run eagerly, on the card too: the yardstick
#: the graph is held to, and the decode of a run that records or patches
#: ``decode_step`` (a graph calls it only while capturing).  It binds this
#: :func:`decode`, so a run may swap ``serve.decode`` for it.
decode_eager = functools.partial(decode, graph=False)


def serve(arch: str, smoke: bool = True, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, temperature: float = 0.0, seed: int = 0,
          device="cuda"):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens (:func:`decode`: one graph replay a step on the card).
    Weights are drawn from ``torch.Generator`` seed 0 on the device,
    prompts from numpy seed ``seed``, temperature samples from a generator
    seeded ``seed``.  Returns the reference's dict plus the parameter
    bytes, the synchronised prefill time, ``decode_s`` (the steps alone),
    ``capture_s`` (the decode step's warm-up and capture; the reference's
    ``decode_s`` holds its first call's compile), the graphs captured, the
    kernel launches of each phase and, for a MoE model, ``drop_share``:
    the prefill's (token, slot) pairs dropped past capacity over all it
    routed (B·S·K a layer, summed over the layers; None for a dense
    model)."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config(arch, smoke=smoke)
    fam = get_family(cfg)
    model = init_model(fam, cfg, torch.Generator(dev).manual_seed(0))
    media = make_media(cfg, batch, dev)
    max_seq = prompt_len + gen

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(2, cfg.vocab_size, size=(batch, prompt_len)),
        dtype=torch.int32, device=dev)
    sampler = torch.Generator(dev).manual_seed(seed)
    routing = [] if cfg.is_moe else None
    moe = {} if routing is None else {"routing": routing}

    with torch.no_grad():
        n0 = launch_counts()
        sync()
        t0 = time.perf_counter()
        logits, cache = fam.prefill(model, cfg, prompts, max_seq=max_seq,
                                    media=media, **moe)
        sync()
        t_prefill = time.perf_counter() - t0
        n1 = launch_counts()
        first = pick(logits[:, -1], temperature, sampler)
        captures = CAPTURE_COUNT
        out = decode(fam, model, cfg, cache, first, prompt_len, gen,
                     temperature=temperature, sampler=sampler, media=media)
        captures = CAPTURE_COUNT - captures
        n2 = launch_counts()
    drop_share = None
    if routing:
        routed = len(routing) * batch * prompt_len * cfg.experts_per_token
        drop_share = int(sum(r.dropped for r in routing)) / routed
    return {
        "tokens": out["tokens"],
        "prefill_s": t_prefill,
        "decode_s": out["decode_s"],
        "capture_s": out["capture_s"],
        "captures": captures,
        "tok_per_s": batch * (gen - 1) / max(out["decode_s"], 1e-9),
        "param_bytes": model.param_bytes(),
        "launches": {"prefill": {k: n1[k] - n0[k] for k in n0},
                     "decode": {k: n2[k] - n1[k] for k in n1}},
        "drop_share": drop_share,
        "device": str(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = serve(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen,
              temperature=args.temperature, device=args.device)
    print(f"prefill {r['prefill_s']*1e3:.1f} ms, decode {r['decode_s']*1e3:.1f} ms "
          f"(capture {r['capture_s']*1e3:.1f} ms, graphs {r['captures']}), "
          f"{r['tok_per_s']:.1f} tok/s, sample row: {r['tokens'][0][:12]}; "
          f"launches {r['launches']} on {r['device']}"
          + ("" if r["drop_share"] is None else
             f"; prefill capacity drops {r['drop_share']:.4%}"))
    return r


if __name__ == "__main__":
    main()
