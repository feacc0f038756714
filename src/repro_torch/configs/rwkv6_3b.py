"""rwkv6-3b [ssm]: 32L d=2560 (attention-free) ff=8960 vocab=65536.

RWKV-6 "Finch" [arXiv:2404.05892]: data-dependent decay WKV recurrence,
token-shift ddlerp, 40 heads x 64. Sub-quadratic: runs the 500k decode cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    rwkv=True, rwkv_head_dim=64, rwkv_lora_dim=64,
    rope=False,
)
