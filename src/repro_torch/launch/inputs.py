"""Shape-and-sharding stand-ins for every model input, with no storage:
the reference's ``launch/inputs.py``.  Each is a :class:`ShapeDtypeStruct`
(shape, dtype and a :class:`~repro_torch.distributed.sharding.NamedSharding`
of the mesh and the spec its logical axes resolve to), the counterpart of a
sharded ``jax.ShapeDtypeStruct``.  Cache shapes come from the family's
``init_cache`` on the ``meta`` device, where the reference uses
``jax.eval_shape``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import NamedSharding, ShardingRules
from repro_torch.models.common import get_family
from repro_torch.nn.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding

    @property
    def spec(self):
        return self.sharding.spec


def _sds(shape, dtype, mesh, rules, axes):
    shape = tuple(int(s) for s in shape)
    spec = rules.pspec(axes, shape, mesh)
    return ShapeDtypeStruct(shape, dtype, NamedSharding(mesh, spec))


def _media(cfg: ModelConfig, B: int, mesh, rules):
    return _sds((B, cfg.n_media_tokens, cfg.d_model), torch.float32, mesh,
                rules, ("batch", None, "embed_act"))


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: ShardingRules):
    """Inputs for a train step: {tokens, labels[, media]}."""
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": _sds((B, S), torch.int32, mesh, rules, ("batch", "seq")),
        "labels": _sds((B, S), torch.int32, mesh, rules, ("batch", "seq")),
    }
    if cfg.family in ("encdec", "vlm"):
        out["media"] = _media(cfg, B, mesh, rules)
    return out


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  rules: ShardingRules):
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((B, S), torch.int32, mesh, rules, ("batch", "seq"))}
    if cfg.family in ("encdec", "vlm"):
        out["media"] = _media(cfg, B, mesh, rules)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: ShardingRules):
    """Decode caches with the family's cache sharding rules."""
    fam = get_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    shapes = fam.init_cache(cfg, B, S, device="meta")
    axes = fam.cache_logical_axes(cfg)
    return {k: _sds(v.shape, v.dtype, mesh, rules, axes[k])
            for k, v in shapes.items()}


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 rules: ShardingRules):
    B = shape.global_batch
    tokens = _sds((B, 1), torch.int32, mesh, rules, ("batch", None))
    cache = cache_specs(cfg, shape, mesh, rules)
    return {"tokens": tokens, "cache": cache}
