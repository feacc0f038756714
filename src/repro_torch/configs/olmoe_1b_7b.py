"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) expert_ff=1024 vocab=50304, 64e top-8.

[arXiv:2409.02060]: fully sparse MoE, 64 experts top-8, qk-norm.
AWAPart expert placement applies (rank-granularity dispatch).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    n_experts=64, top_k=8, qk_norm=True,
)
