"""Per-architecture distribution strategy: sharding-rule overrides and
microbatch accumulation — the paper-faithful baseline placements.

The auto divisibility fallback in ShardingRules handles awkward head/expert
counts (qwen2's 12 heads, whisper's 20, granite's 40 experts, hymba's 25)
by replicating that axis; §Perf iterates on these choices per-cell.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed.sharding import ShardingRules, make_rules
from repro_torch.nn.config import ModelConfig
from repro_torch.train.steps import TrainConfig


# arch name -> rule overrides (applied on top of DEFAULT_RULES)
RULE_OVERRIDES: dict[str, dict] = {
    # granite: 40 experts don't divide the model axis -> keep experts
    # unsharded, TP inside experts, shard the dispatch-grid capacity dim
    # (the "moe_cap" rule) so grids never replicate.
    "granite-moe-3b-a800m": {"experts": None, "mlp": "model"},
    # rwkv: projections are (E,E); shard output channels over model.
    "rwkv6-3b": {"heads": "model"},
    # deepseek: experts are model-sharded (EP); sharding the dispatch-grid
    # capacity over data doubles collective volume (measured 82 -> 169 s),
    # so the grid capacity dim stays local to each expert owner.
    "deepseek-v2-236b": {"moe_cap": None},
}

# shape kind -> accumulation steps (memory: full-batch logits cannot fit)
ACCUM = {"train_4k": 8}


def rules_for(cfg: ModelConfig) -> ShardingRules:
    return make_rules(**RULE_OVERRIDES.get(cfg.name, {}))


def train_config_for(cfg: ModelConfig, shape_name: str) -> TrainConfig:
    return TrainConfig(accum_steps=ACCUM.get(shape_name, 1))
