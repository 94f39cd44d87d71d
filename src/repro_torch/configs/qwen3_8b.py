"""qwen3-8b: 36L d=4096 32H (GQA kv=8) hd=128 d_ff=12288 vocab=151936.
qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qk_norm=True, tie_embeddings=False,
    pad_vocab_multiple=16,
)
