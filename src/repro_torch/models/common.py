"""Shared model machinery: embeddings, the module tree of a family's
parameters, carrying the reference's parameters across, and the registry.

A model is a :class:`Model`: ``embed`` (a :class:`Params` node of the
embedding template) and ``layers`` (an ``nn.ModuleList`` of per-layer
:class:`Params`), where the reference stacks the layers on a leading axis
and scans over them.  The family functions take the model where the
reference takes its parameter tree.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import rmsnorm, rmsnorm_template
from repro_torch.nn.param import Params, init_params, spec


def embed_template(cfg: ModelConfig):
    t = {
        "tok": spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                    init="embed", scale=0.02),
        "final_norm": rmsnorm_template(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = spec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"),
                            scale=0.02)
    return t


_EMBED_SCALES: dict = {}


def embed_scale(d_model: int, dtype) -> float:
    """gemma's embedding factor: ``sqrt(d_model)`` computed in ``dtype``, as
    the reference computes it, kept as a Python float.  Made once per
    (width, type) on the host, so a decode step captured as a CUDA graph
    copies nothing from host memory; a tensor times this float gives the
    bits of the tensor times the 0-d tensor of ``dtype``."""
    key = (d_model, dtype)
    if key not in _EMBED_SCALES:
        _EMBED_SCALES[key] = float(torch.sqrt(torch.tensor(d_model,
                                                           dtype=dtype)))
    return _EMBED_SCALES[key]


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = params["tok"][tokens.long()].to(cfg.cdtype())
    if cfg.name.startswith("gemma"):
        x = x * embed_scale(cfg.d_model, x.dtype)
    return x


def unembed(params, cfg: ModelConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params.cast("tok", x.dtype).T
    else:
        logits = x @ params.cast("unembed", x.dtype)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


class Model(nn.Module):
    """A family's parameters as modules (``embed``, ``layers``), in the
    reference's shapes with the layer axis split off."""

    def __init__(self, cfg: ModelConfig, layer_template, dtype=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype or cfg.pdtype()
        self.embed = Params(embed_template(cfg), dtype, device)
        self.layers = nn.ModuleList(
            Params(layer_template(cfg), dtype, device)
            for _ in range(cfg.n_layers))

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())


def _fill(node: Params, tree, index=None):
    if set(tree) != set(node.keys()):
        raise ValueError(f"parameter tree keys {sorted(tree)} != "
                         f"{sorted(node.keys())}")
    for name in node.keys():
        target, src = node[name], tree[name]
        if isinstance(target, Params):
            _fill(target, src, index)
            continue
        if index is not None:
            src = src[index]
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.array(src))
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(target.shape)}")
        if src.device == target.device and src.dtype == target.dtype:
            target.data = src                 # a view: no copy
        else:
            target.data.copy_(src)


def load_reference_params(model: Model, tree) -> Model:
    """Fill ``model`` from a parameter tree of the reference's layout
    (``{"embed": ..., "layers": ...}`` with the layers stacked on a leading
    axis of length L), by path: numpy arrays (the reference's
    ``jax.tree.map(np.asarray, params)``) are copied in; tensors already of
    the model's device and type are taken as views, not copied."""
    _fill(model.embed, tree["embed"])
    for i, layer in enumerate(model.layers):
        _fill(layer, tree["layers"], i)
    model.embed.drop_casts()
    for layer in model.layers:
        layer.drop_casts()
    return model


def init_model(fam, cfg: ModelConfig, generator: torch.Generator) -> Model:
    """A model of ``fam`` with parameters drawn by :func:`init_params` from
    ``generator`` (on its device, in ``cfg.pdtype()``)."""
    tree = init_params(fam.template(cfg), generator, dtype=cfg.pdtype())
    model = fam.build(cfg, device=generator.device)
    return load_reference_params(model, tree)


# -- registry ----------------------------------------------------------------

_REGISTRY: dict[str, Any] = {}
NOT_PORTED = ("hybrid", "encdec", "vlm")


def register_family(name: str):
    def deco(mod):
        _REGISTRY[name] = mod
        return mod
    return deco


def not_ported(what: str) -> str:
    """The message of a refused family or layer."""
    return (f"{what} is not ported to repro_torch yet (see ROADMAP.md, "
            "Queue 1 item 6, the model substrate); the ported families are "
            "the dense and MoE LMs without MLA, and RWKV6")


def get_family(cfg_or_name) -> Any:
    """The family module of a config (or family name).  The dense and MoE
    LMs and RWKV6 are ported; MLA attention and the other families raise
    NotImplementedError."""
    cfg = None if isinstance(cfg_or_name, str) else cfg_or_name
    name = cfg_or_name if cfg is None else cfg.family
    if name in NOT_PORTED:
        raise NotImplementedError(not_ported(f"the {name!r} family"))
    if cfg is not None and cfg.use_mla:
        raise NotImplementedError(not_ported("MLA attention"))
    import repro_torch.models.lm      # noqa: F401
    import repro_torch.models.rwkv    # noqa: F401
    return _REGISTRY[name]
