"""deepseek-v2-236b: 60L d=5120 128H MLA (q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128), MoE 160 routed experts top-6 +
2 shared, expert d_ff=1536, vocab=102400. All layers MoE (the published
model's single dense first layer is folded into the uniform stack; noted
in DESIGN.md). [arXiv:2405.04434; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=1536, vocab_size=102400,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    n_experts=160, n_shared_experts=2, experts_per_token=6,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=32, vocab_size=512,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
    n_experts=8, n_shared_experts=1, experts_per_token=2,
    capacity_factor=4.0,  # dropless at smoke scale: decode==forward exactly
    tie_embeddings=False, pad_vocab_multiple=16,
)
