"""chameleon-34b [vlm]: 48L d=8192 64H (GQA kv=8) ff=22016 vocab=65536.

Early-fusion mixed-modal decoder [arXiv:2405.09818]; image VQ tokens share
the 65536 vocab, so the modality frontend is the (stub) VQ tokenizer and the
backbone is a plain decoder with qk-norm (Chameleon's stability fix).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, rope=True,
)
