"""Model serving: batched prefill + decode loop with the family's cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 32

Runs on the card (``--device cuda``, the default) unless asked for the CPU;
``--no-smoke`` serves the full published configuration.  The prefill runs
the family's kernel (K5 flash attention for the dense and MoE LMs, K6 WKV6
for RWKV6); the greedy or temperature decode runs plain PyTorch, as the
reference's does.  A MoE model's prefill drops the (token, slot) pairs past
its experts' capacity; the serve reports their share.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine_torch import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models.common import get_family, init_model


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


def serve(arch: str, smoke: bool = True, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, temperature: float = 0.0, seed: int = 0,
          device="cuda"):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens.  Weights are drawn from ``torch.Generator`` seed 0 on the
    device, prompts from numpy seed ``seed``, temperature samples from a
    generator seeded ``seed``.  Returns the reference's dict plus the
    parameter bytes, the synchronised prefill/decode times, the kernel
    launches of each phase and, for a MoE model, ``drop_share``: the
    prefill's (token, slot) pairs dropped past capacity over all it routed
    (B·S·K a layer, summed over the layers; None for a dense model)."""
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

        def pick(lg):
            if temperature > 0:
                p = torch.softmax(lg.float() / temperature, dim=-1)
                return torch.multinomial(p, 1, generator=sampler).to(
                    torch.int32)
            return torch.argmax(lg, dim=-1).to(torch.int32)[:, None]

        tok = pick(logits[:, -1])
        out = [tok]
        sync()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = fam.decode_step(model, cfg, cache, tok,
                                            prompt_len + i, media=media)
            tok = pick(logits[:, 0])
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu().numpy()
        sync()
        t_decode = time.perf_counter() - t0
        n2 = launch_counts()
    drop_share = None
    if routing:
        routed = len(routing) * batch * prompt_len * cfg.experts_per_token
        drop_share = int(sum(r.dropped for r in routing)) / routed
    return {
        "tokens": toks,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
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
    print(f"prefill {r['prefill_s']*1e3:.1f} ms, decode {r['decode_s']*1e3:.1f} ms, "
          f"{r['tok_per_s']:.1f} tok/s, sample row: {r['tokens'][0][:12]}; "
          f"launches {r['launches']} on {r['device']}"
          + ("" if r["drop_share"] is None else
             f"; prefill capacity drops {r['drop_share']:.4%}"))
    return r


if __name__ == "__main__":
    main()
