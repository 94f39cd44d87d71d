"""mistral-nemo-12b: 40L d=5120 32H (GQA kv=8) hd=128 d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.nn.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="mistral-nemo-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, tie_embeddings=False, pad_vocab_multiple=16,
)
