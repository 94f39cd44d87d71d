"""Shared model machinery: embeddings, the loss, remat of a layer body,
the module tree of a family's parameters, carrying the reference's
parameters across, and the registry.

A model is a :class:`Model`: ``embed`` (a :class:`Params` node of the
embedding template), the family's other unstacked nodes (the enc-dec
family's ``enc_norm``) and its stacks, each an ``nn.ModuleList`` of
per-layer :class:`Params` (``layers``; the enc-dec family's ``encoder``
and ``decoder``), where the reference stacks the layers on a leading axis
and scans over them.  A stack's layer may hold stacks of its own (a
:class:`Layout`): the VLM's ``groups``, each a :class:`Tree` of a
``self`` stack of four layers and an unstacked ``cross`` layer, which the
reference stacks on two leading axes (group, layer) and on one.  The
family functions take the model where the reference takes its parameter
tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (bind_rules, constrain,
                                              is_distributed, run_local,
                                              weight_gather, zeros)
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
    tok = weight_gather(params["tok"], ("vocab", "embed"))
    x = _take_rows(tok, tokens).to(cfg.cdtype())
    if cfg.name.startswith("gemma"):
        x = x * embed_scale(cfg.d_model, x.dtype)
    return constrain(x, ("batch", "seq", "embed_act"))


def _take_rows(tok, tokens):
    """``tok[tokens]``; under a mesh each rank gathers its tokens' rows of
    the replicated table (the gradient of the table is then a partial sum
    over the ranks that hold other tokens)."""
    if not is_distributed(tok, tokens):
        return tok[tokens.long()]
    B, S = tokens.shape
    return run_local(lambda t, ids, _pls: t[ids.long()],
                     [(tok, (None, None)), (tokens, ("batch", "seq"))],
                     [(("batch", "seq", None), (B, S, tok.shape[1]))])


def positions(tokens):
    """The positions ``arange(S)`` of a (B, S) batch, int32, as (B, S)."""
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(B, S)


def unembed(params, cfg: ModelConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params.cast("tok", x.dtype).T
    else:
        logits = x @ params.cast("unembed", x.dtype)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return constrain(logits, ("batch", "seq", "vocab_act"))


def lm_loss(logits, labels, mask=None, z_weight: float = 1e-4):
    """Cross-entropy + z-loss; labels < 0 are ignored (the reference's
    ``lm_loss``, in f32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = _label_logits(logits, labels.clamp_min(0))
    valid = (labels >= 0) if mask is None else (mask & (labels >= 0))
    valid = valid.float()
    ce = (lse - ll) * valid
    z = torch.square(lse) * valid
    denom = valid.sum().clamp_min(1.0)
    return ce.sum() / denom + z_weight * z.sum() / denom


def _label_logits(logits, labels):
    """Each position's logit of its label; under a mesh gathered on each
    rank's rows with the vocabulary replicated."""
    def take(lg, lb, _pls=None):
        return torch.take_along_dim(lg, lb.long()[..., None], dim=-1)[..., 0]
    if not is_distributed(logits, labels):
        return take(logits, labels)
    return run_local(take, [(logits, ("batch", "seq", None)),
                            (labels, ("batch", "seq"))],
                     [(("batch", "seq"), tuple(labels.shape))])


#: the products "dots" saves: matrix products without a batch dim (the
#: reference's ``checkpoint_dots_with_no_batch_dims``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """A layer body ``fn`` under the config's remat policy (the reference's
    ``remat_wrap`` around its scanned bodies): ``"full"`` keeps only the
    body's inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``), ``"dots"`` also keeps the outputs of its
    matrix products, ``"none"`` runs the body as is.  Only under grad: a
    serve or prefill runs the body as is."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if cfg.remat == "none":
        return fn
    kw = {"context_fn": _dots_contexts} if cfg.remat == "dots" else {}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the recomputation runs on autograd's thread, which does not see
        # this one's mesh rules: bind them to it
        return checkpoint(bind_rules(fn), *args, use_reentrant=False, **kw)
    return wrapped


@dataclasses.dataclass(frozen=True)
class Layout:
    """The template of a stack's layer that holds stacks of its own: its
    unstacked ``nodes`` ({name: template}) and its ``stacks`` ({name:
    (layer template or Layout, number of layers)})."""
    nodes: dict
    stacks: dict


class Tree(nn.Module):
    """Unstacked nodes (:class:`Params`) and stacks (``nn.ModuleList`` of
    per-layer :class:`Params`, or of :class:`Tree` for a :class:`Layout`),
    each the module attribute of its name."""

    def __init__(self, nodes, stacks, dtype, device):
        super().__init__()
        self.node_names, self.stack_names = tuple(nodes), tuple(stacks)
        for name, template in nodes.items():
            self.add_module(name, Params(template, dtype, device))
        for name, (template, n) in stacks.items():
            self.add_module(name, nn.ModuleList(
                Tree(template.nodes, template.stacks, dtype, device)
                if isinstance(template, Layout)
                else Params(template, dtype, device) for _ in range(n)))


    def drop_casts(self):
        """Forget every node's cast copies (:meth:`Params.drop_casts`)."""
        for m in self.modules():
            if isinstance(m, Params):
                m._casts.clear()


class Model(Tree):
    """A family's parameters as modules, in the reference's shapes with
    each stack's layer axes split off: ``embed``, the unstacked ``nodes``
    ({name: template}) and the ``stacks`` ({name: (layer template or
    :class:`Layout`, number of layers)}); by default one stack, ``layers``,
    of ``layer_template`` and ``cfg.n_layers``."""

    def __init__(self, cfg: ModelConfig, layer_template=None, dtype=None,
                 device=None, *, stacks=None, nodes=None):
        if stacks is None:
            stacks = {"layers": (layer_template(cfg), cfg.n_layers)}
        super().__init__({"embed": embed_template(cfg), **(nodes or {})},
                         stacks, dtype or cfg.pdtype(), device)
        self.cfg = cfg

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def requires_grad_(self, requires_grad: bool = True):
        """The train path's switch: every parameter requires grad, and
        every :class:`Params` node reads its leaves under grad in the
        config's compute type (``Params.grad_dtype``), as the reference's
        loss casts its parameters; ``False`` turns both off (a serve's
        model)."""
        super().requires_grad_(requires_grad)
        dtype = self.cfg.cdtype() if requires_grad else None
        for m in self.modules():
            if isinstance(m, Params):
                m.grad_dtype = dtype
        return self


def _node_tree(node: Params) -> dict:
    out = {}
    for name in node.keys():
        t = getattr(node, name)
        out[name] = _node_tree(t) if isinstance(t, Params) else t
    return out


def _stacked(layers: list):
    """Trees of one structure, a stack's layers -> one tree whose leaves
    are the lists of the layers' leaves (a nested stack's lists joined in
    layer order)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in layers]) for k in first}
    if isinstance(first, list):
        return [x for t in layers for x in t]
    return list(layers)


def param_tree(model: Tree) -> dict:
    """The model's parameters (the tensors themselves) in the reference's
    parameter tree: the same keys at every level; where the reference
    stacks a leaf over a stack's layers, the list of the per-layer
    parameters in stack order (a nested stack's in (outer, inner) order,
    as the reference's two stacking axes are laid out).  Walked as
    :mod:`repro_torch.tree` walks it, its leaves come in the reference's
    leaf order, each stacked leaf's layers one after the other."""
    out = {name: _node_tree(getattr(model, name)) for name in model.node_names}
    for name in model.stack_names:
        out[name] = _stacked([param_tree(layer) if isinstance(layer, Tree)
                              else _node_tree(layer)
                              for layer in getattr(model, name)])
    return out


def _fill(node: Params, tree, index=None):
    """Fill ``node`` from ``tree``, each leaf indexed by ``index``, the
    layer's place in its stacks (an int, or a tuple in a nested stack): a
    stacked 0-d leaf (the VLM's gates) gives a 0-d tensor."""
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


def _fill_tree(mod: Tree, tree, index=()) -> list:
    """Fill ``mod``'s nodes and stacks from ``tree`` at its place
    ``index`` in the stacks around it -> the :class:`Params` filled."""
    names = set(mod.node_names) | set(mod.stack_names)
    if set(tree) != names:
        raise ValueError(f"parameter tree keys {sorted(tree)} != "
                         f"{sorted(names)}")
    filled = []
    for name in mod.node_names:
        node = getattr(mod, name)
        _fill(node, tree[name], index or None)
        filled.append(node)
    for name in mod.stack_names:
        for i, layer in enumerate(getattr(mod, name)):
            if isinstance(layer, Tree):
                filled += _fill_tree(layer, tree[name], (*index, i))
            else:
                _fill(layer, tree[name], (*index, i))
                filled.append(layer)
    return filled


def load_reference_params(model: Model, tree) -> Model:
    """Fill ``model`` from a parameter tree of the reference's layout (its
    unstacked nodes, ``{"embed": ...}`` and the enc-dec family's
    ``enc_norm``, and its stacks, ``layers`` or ``encoder`` and
    ``decoder``, each stacked on a leading axis of its length; the VLM's
    ``groups``, whose ``self`` leaves are stacked on two, (group, layer),
    and ``cross`` leaves on one), by path: numpy arrays (the reference's
    ``jax.tree.map(np.asarray, params)``) are copied in; tensors already of
    the model's device and type are taken as views, not copied.  A model
    built on the meta device takes the tree's tensors as they are, on their
    own device.  A tree whose keys differ from the model's nodes and
    stacks, at any depth, is refused."""
    for node in _fill_tree(model, tree):
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


def prefill_cache(fam, cfg: ModelConfig, batch: int, max_seq: int, tokens):
    """The zero cache a prefill of ``tokens`` fills: ``fam.init_cache`` on
    the tokens' device; under a mesh (DTensor tokens) each entry a DTensor
    of the family's cache sharding, made from this rank's shard alone."""
    if not is_distributed(tokens):
        return fam.init_cache(cfg, batch, max_seq, device=tokens.device)
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():      # shapes only, outside any trace
        shapes = fam.init_cache(cfg, batch, max_seq, device="meta")
    axes = fam.cache_logical_axes(cfg)
    return {k: zeros(v.shape, v.dtype, axes[k], tokens.device)
            for k, v in shapes.items()}


def put_rows(entry, index: tuple, row, S: int) -> None:
    """``entry[(*index, :, :S)] = row``: a prefill's S positions of one
    layer's (B, T, ...) cache rows.  Where S is the whole length T the
    layer is written whole: a DTensor cache, whose positions the ranks
    split, takes no slice of them."""
    if entry.shape[len(index) + 1] == S:
        entry[index] = row
    else:
        entry[(*index, slice(None), slice(None, S))] = row


def cache_batch(fam, cache) -> int:
    """The batch of ``fam``'s cache: axis 1 of its tensors, (L, B, ...),
    or the family's own ``cache_batch`` (the VLM's self K/V are (G,
    GROUP - 1, B, ...))."""
    if hasattr(fam, "cache_batch"):
        return fam.cache_batch(cache)
    return next(iter(cache.values())).shape[1]


# -- registry ----------------------------------------------------------------

_REGISTRY: dict[str, Any] = {}


def register_family(name: str):
    def deco(mod):
        _REGISTRY[name] = mod
        return mod
    return deco


def get_family(cfg_or_name) -> Any:
    """The family module of a config (or family name).  Every family of
    the reference is ported: the dense and MoE LMs (with MHA / GQA or MLA
    attention) in ``lm``, RWKV6 in ``rwkv``, the hybrid family (hymba) in
    ``hymba``, the enc-dec family (whisper) in ``encdec`` and the VLM
    family (llama-3.2-vision) in ``vlm``."""
    name = cfg_or_name if isinstance(cfg_or_name, str) else cfg_or_name.family
    import repro_torch.models.encdec  # noqa: F401
    import repro_torch.models.hymba   # noqa: F401
    import repro_torch.models.lm      # noqa: F401
    import repro_torch.models.rwkv    # noqa: F401
    import repro_torch.models.vlm     # noqa: F401
    return _REGISTRY[name]
