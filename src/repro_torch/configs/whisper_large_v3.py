"""whisper-large-v3 backbone: 32 enc + 32 dec layers, d=1280 20H (MHA)
hd=64 d_ff=5120 vocab=51866 (padded to 51872 for 16-way TP).
Conv/mel frontend is a stub: input_specs provides (B,1500,1280) frame
embeddings. [arXiv:2212.04356; unverified]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    head_dim=64, d_ff=5120, vocab_size=51866, n_media_tokens=1500,
    tie_embeddings=True, pad_vocab_multiple=32,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, n_media_tokens=24,
    tie_embeddings=True, pad_vocab_multiple=16,
)
