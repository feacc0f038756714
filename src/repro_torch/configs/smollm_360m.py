"""smollm-360m [dense]: 32L d=960 15H (GQA kv=5) ff=2560 vocab=49152.

Llama-architecture small model [hf:HuggingFaceTB/SmolLM-360M]: RoPE, RMSNorm,
SwiGLU, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152,
    tied_embeddings=True,
)
