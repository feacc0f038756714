"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) ff=27648 vocab=152064.

[hf:Qwen/Qwen2.5-32B]: GQA with QKV bias, RoPE theta 1e6.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
)
