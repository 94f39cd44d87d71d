"""gemma3-12b: 48L d=3840 16H (GQA kv=8) hd=256 d_ff=15360 vocab=262144.
5:1 local(1024-window):global attention, qk-norm, 128k ctx.
[hf:google/gemma-3-1b-pt scaled per assignment; unverified]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    window=1024, global_every=6, qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    window=8, global_every=6, qk_norm=True, tie_embeddings=True,
    pad_vocab_multiple=16,
)
