"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) ff=24576 vocab=49152.

[arXiv:2402.19173]: GQA, RoPE, LayerNorm, GELU MLP, attention/MLP biases.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    qkv_bias=True, norm="layernorm", activation="gelu",
)
