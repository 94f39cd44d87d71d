"""llama-3.2-vision-90b backbone: 100L (20 groups of 4 self + 1 gated
cross-attn) d=8192 64H (GQA kv=8) hd=128 d_ff=28672 vocab=128256.
Vision tower is a stub: input_specs provides (B,1601,8192) patch
embeddings. [hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, n_media_tokens=1601, cross_every=5,
    rope_theta=500_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, n_media_tokens=12, cross_every=5,
    tie_embeddings=False, pad_vocab_multiple=16,
)
