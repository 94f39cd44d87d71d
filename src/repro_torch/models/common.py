"""Shared model machinery: embeddings, the module tree of a family's
parameters, carrying the reference's parameters across, and the registry.

A model is a :class:`Model`: ``embed`` (a :class:`Params` node of the
embedding template), the family's other unstacked nodes (the enc-dec
family's ``enc_norm``) and its stacks, each an ``nn.ModuleList`` of
per-layer :class:`Params` (``layers``; the enc-dec family's ``encoder``
and ``decoder``), where the reference stacks the layers on a leading axis
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
    """A family's parameters as modules, in the reference's shapes with
    each stack's layer axis split off: ``embed``, the unstacked ``nodes``
    ({name: template}) and the ``stacks`` ({name: (layer template, number
    of layers)}); by default one stack, ``layers``, of ``layer_template``
    and ``cfg.n_layers``."""

    def __init__(self, cfg: ModelConfig, layer_template=None, dtype=None,
                 device=None, *, stacks=None, nodes=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype or cfg.pdtype()
        if stacks is None:
            stacks = {"layers": (layer_template(cfg), cfg.n_layers)}
        nodes = {"embed": embed_template(cfg), **(nodes or {})}
        self.node_names, self.stack_names = tuple(nodes), tuple(stacks)
        for name, template in nodes.items():
            self.add_module(name, Params(template, dtype, device))
        for name, (template, n) in stacks.items():
            self.add_module(name, nn.ModuleList(
                Params(template, dtype, device) for _ in range(n)))

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
        if target.device.type == "meta":      # built without memory
            setattr(node, name, nn.Parameter(src.to(target.dtype),
                                             requires_grad=False))
        elif src.device == target.device and src.dtype == target.dtype:
            target.data = src                 # a view: no copy
        else:
            target.data.copy_(src)


def load_reference_params(model: Model, tree) -> Model:
    """Fill ``model`` from a parameter tree of the reference's layout (its
    unstacked nodes, ``{"embed": ...}`` and the enc-dec family's
    ``enc_norm``, and its stacks, ``layers`` or ``encoder`` and
    ``decoder``, each stacked on a leading axis of its length), by path:
    numpy arrays (the reference's ``jax.tree.map(np.asarray, params)``) are
    copied in; tensors already of the model's device and type are taken as
    views, not copied.  A model built on the meta device takes the tree's
    tensors as they are, on their own device."""
    names = set(model.node_names) | set(model.stack_names)
    if set(tree) != names:
        raise ValueError(f"parameter tree keys {sorted(tree)} != "
                         f"{sorted(names)}")
    nodes = [getattr(model, name) for name in model.node_names]
    for name, node in zip(model.node_names, nodes):
        _fill(node, tree[name])
    for name in model.stack_names:
        for i, layer in enumerate(getattr(model, name)):
            _fill(layer, tree[name], i)
            nodes.append(layer)
    for node in nodes:
        node.drop_casts()
    return model


def init_model(fam, cfg: ModelConfig, generator: torch.Generator) -> Model:
    """A model of ``fam`` with parameters drawn by :func:`init_params` from
    ``generator`` (on its device, in ``cfg.pdtype()``).  The model is built
    on the meta device and takes the drawn tensors as views, so the
    parameters are held once (deepseek-v2's 4 layers fill 34 GB in bf16;
    whisper-large-v3's two stacks 6.1 GB in f32)."""
    tree = init_params(fam.template(cfg), generator, dtype=cfg.pdtype())
    model = fam.build(cfg, device="meta")
    return load_reference_params(model, tree)


# -- registry ----------------------------------------------------------------

_REGISTRY: dict[str, Any] = {}
NOT_PORTED = ("vlm",)


def register_family(name: str):
    def deco(mod):
        _REGISTRY[name] = mod
        return mod
    return deco


def not_ported(what: str) -> str:
    """The message of a refused family."""
    return (f"{what} is not ported to repro_torch yet (see ROADMAP.md, "
            "Queue 1 item 6, the model substrate); the ported families are "
            "the dense and MoE LMs (MLA attention included), RWKV6, the "
            "hybrid (hymba: attention and Mamba heads) and the enc-dec "
            "family (whisper: encoder, decoder and cross-attention); the "
            "VLM family is still refused")


def get_family(cfg_or_name) -> Any:
    """The family module of a config (or family name).  The dense and MoE
    LMs (with MHA / GQA or MLA attention), RWKV6, the hybrid family
    (hymba) and the enc-dec family (whisper) are ported; the VLM family
    raises NotImplementedError."""
    cfg = None if isinstance(cfg_or_name, str) else cfg_or_name
    name = cfg_or_name if cfg is None else cfg.family
    if name in NOT_PORTED:
        raise NotImplementedError(not_ported(f"the {name!r} family"))
    import repro_torch.models.encdec  # noqa: F401
    import repro_torch.models.hymba   # noqa: F401
    import repro_torch.models.lm      # noqa: F401
    import repro_torch.models.rwkv    # noqa: F401
    return _REGISTRY[name]
