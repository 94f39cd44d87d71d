"""granite-moe-3b-a800m: 32L d=1536 24H (GQA kv=8) hd=64, MoE 40 experts
top-8, expert d_ff=512, vocab=49155 (padded 49168).
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, n_shared_experts=0, experts_per_token=8,
    moe_impl="grid_local",  # replicated experts: batch-local dispatch (§Perf It.12)
    tie_embeddings=True, pad_vocab_multiple=16,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=512,
    n_experts=8, n_shared_experts=0, experts_per_token=2,
    capacity_factor=4.0,  # dropless at smoke scale: decode==forward exactly
    tie_embeddings=True, pad_vocab_multiple=16,
)
