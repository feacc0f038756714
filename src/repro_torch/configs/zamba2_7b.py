"""zamba2-7b [hybrid]: 81L d=3584 32H (kv=32) ff=14336 vocab=32000, ssm_state=64.

Mamba2 backbone with a shared attention+MLP block applied periodically
[arXiv:2411.15242]. The shared block reuses one parameter set (Zamba's
signature memory saving).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,
)
