"""rwkv6-3b (Finch): 32L d=2560 attention-free, d_ff=8960 vocab=65536.
Data-dependent per-channel decay; 40 WKV heads of dim 64; O(1) decode
state. [arXiv:2404.05892; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536, n_ssm_heads=40,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, n_ssm_heads=4, tie_embeddings=False,
    pad_vocab_multiple=16,
)
