"""qwen2-1.5b: 28L d=1536 12H (GQA kv=2) hd=128 d_ff=8960 vocab=151936.
GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    pad_vocab_multiple=16,
)
