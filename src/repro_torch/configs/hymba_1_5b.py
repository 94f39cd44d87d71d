"""hymba-1.5b: 32L d=1600 25H (GQA kv=5) hd=64 d_ff=5504 vocab=32001
(padded 32016), ssm_state=16 — parallel attention + Mamba heads,
sliding-window attention except global layers {0, 15, 31}.
Meta-tokens omitted (noted in DESIGN.md). [arXiv:2411.13676; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, ssm_state=16,
    window=1024, global_layers=(0, 15, 31),
    tie_embeddings=True, pad_vocab_multiple=16,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=8,
    window=8, global_layers=(0,),
    tie_embeddings=True, pad_vocab_multiple=16,
)
