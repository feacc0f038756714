"""qwen3-0.6b [dense]: 28L d=1024 16H (GQA kv=8) ff=3072 vocab=151936.

[hf:Qwen/Qwen3-0.6B]: qk-norm, GQA, explicit head_dim=128, no QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
)
