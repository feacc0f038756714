"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) expert_ff=768, 128e top-8.

[hf:Qwen/Qwen3-30B-A3B]: 128 experts top-8, qk-norm, head_dim=128,
vocab 151936. AWAPart expert placement applies.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    n_experts=128, top_k=8, qk_norm=True, rope_theta=1e6,
)
